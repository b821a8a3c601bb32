"""Tests of the benchmark harness (CPU; ``card`` tests skip without one)."""
