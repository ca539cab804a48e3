"""Experiment IO: JSON export (reference schema) and offline metrics."""
