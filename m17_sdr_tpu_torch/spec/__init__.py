"""M17 protocol layer: constants and batched bit transforms (receive side)."""
