"""Materials, sampling and the area light."""
