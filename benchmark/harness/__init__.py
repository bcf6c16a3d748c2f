"""The harness: cells by name, fixtures, the traffic generator, the window, the trace and the check."""
