"""The plain reference that decides ``correct``: frozen pure-Python BLS12-381 and per-set verification."""
