"""Solver math: schedulers, NS solvers (Algorithm 1), taxonomy (Theorem 3.2)."""
