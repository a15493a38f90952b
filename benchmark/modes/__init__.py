"""Ways of driving the program, one module each, named by a traffic mix's `mode`."""
