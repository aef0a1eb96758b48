"""Fabricated inputs for the port's tests and chip smoke run."""
