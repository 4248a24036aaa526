"""Weights import and host-side helpers."""
