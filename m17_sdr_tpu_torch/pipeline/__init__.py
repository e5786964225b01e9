"""End-to-end receive pipeline."""
