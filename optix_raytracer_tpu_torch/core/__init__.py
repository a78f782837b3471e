"""RNG, vector math, rays, camera and film."""
