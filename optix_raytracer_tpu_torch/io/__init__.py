"""Image input and output: PPM, PNG, EXR and NPZ, and the ASCII preview."""
