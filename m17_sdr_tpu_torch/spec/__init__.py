"""M17 protocol layer: constants, codecs and batched bit transforms."""
