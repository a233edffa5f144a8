"""The DALL·E transformer, the dVAE decoder and their composition."""
