"""Targets."""
