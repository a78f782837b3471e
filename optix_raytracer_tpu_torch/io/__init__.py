"""Image output."""
