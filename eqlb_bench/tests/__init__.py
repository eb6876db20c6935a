"""Tests of the benchmark (CPU, tiny sizes; ``card`` tests on a card)."""
