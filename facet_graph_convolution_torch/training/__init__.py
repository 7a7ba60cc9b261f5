"""Training: the normals-supervised train step and loop, Adam, checkpoints."""
