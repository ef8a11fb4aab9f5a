"""SwinUNETR with cross-attention fusion, its factory and the weight
converter from the JAX package's params tree."""
