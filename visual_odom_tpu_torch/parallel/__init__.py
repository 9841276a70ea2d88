"""Several sequences at once on one card."""
