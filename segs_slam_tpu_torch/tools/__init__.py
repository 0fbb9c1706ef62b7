"""Measurement scripts for the port that run on a card."""
