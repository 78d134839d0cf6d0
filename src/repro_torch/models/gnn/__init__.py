"""Graph neural networks of the port: PNA (``pna``) and its neighbour
sampler (``sampler``)."""
