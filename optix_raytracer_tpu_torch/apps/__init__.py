"""Sample apps of the port."""
