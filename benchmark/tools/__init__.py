"""Tools run once, by hand, to set the benchmark's numbers: the roofline fit, the knee sweep and the control."""
