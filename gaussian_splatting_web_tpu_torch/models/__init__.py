"""Trainable scene model."""
