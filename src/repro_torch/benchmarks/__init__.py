"""Benchmark twins of the reference's ``benchmarks/`` runners, inside the port."""
