"""Several sequences at once on one card, device meshes, and the step
pipelined over two devices or two streams of one card."""
