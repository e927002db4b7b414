"""Samplers."""
