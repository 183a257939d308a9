"""The plain reference: PyTorch and the standard library only. It imports
nothing of the program under test, nor JAX, nor the JAX package."""
