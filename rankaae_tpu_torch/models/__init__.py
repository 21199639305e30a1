"""FC model zoo: encoder, decoder, discriminator and their primitives."""
