"""Ruya's pipeline in the port: profiling, memory model, split, GP+EI search."""
