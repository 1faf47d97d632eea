"""Utilities: procedural noise."""
