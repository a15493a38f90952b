"""Plain PyTorch references the checks hold the program to; they import
nothing of the program, of JAX or of the JAX package."""
