"""The plain reference: CSM-1B and Mimi's decoder in plain PyTorch, and
CSM's prompt rows.  Nothing here imports the program under test, JAX or
the JAX package."""
