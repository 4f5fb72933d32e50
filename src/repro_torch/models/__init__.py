"""Dense decoder model: layers, blocks, the `Model` module and the params
converter from the reference's pytree."""
