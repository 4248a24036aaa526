"""Offline evaluation: the corpus round trip and its throughput report."""
