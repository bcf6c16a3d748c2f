"""Payload kinds, one module each, found by the name a mix file gives."""
