"""Benchmarks of the port, run on the card (counterparts of the JAX
package's bench/ scripts)."""
