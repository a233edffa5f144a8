"""The DALL·E transformer, the dVAE, CLIP and their composition."""
