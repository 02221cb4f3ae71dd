"""Launchers of the port's LM harness."""
