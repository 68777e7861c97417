"""The SD UNet and the weight carry-across from the JAX package."""
