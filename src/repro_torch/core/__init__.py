"""Flat parameter layout, dict-of-tensor algebra, aggregation and selection."""
