"""The plain reference: CSM-1B and Mimi's decoder in plain PyTorch,
CSM's prompt rows, and the served tokens' gaps in reference logits.
Nothing here imports the program under test, JAX or the JAX package."""
