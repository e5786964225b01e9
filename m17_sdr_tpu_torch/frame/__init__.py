"""M17 link layer on the receive path: timing recovery, framer, frame decode."""
