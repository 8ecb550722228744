"""Summaries of the PyTorch port: dense labels, the forest carry, the
group-fold contract, the signed double cover (bipartiteness) and the host
adjacency of the spanner."""
