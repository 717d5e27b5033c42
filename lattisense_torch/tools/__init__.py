"""Measurement scripts for the card (run as modules)."""
