"""Fr (BLS12-377 scalar field): constants, oracle, tensor layout and codec."""
