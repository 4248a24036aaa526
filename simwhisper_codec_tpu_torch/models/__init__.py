"""Codec modules: transformer stacks, frame-stack samplers, Vocos, the codec."""
