"""Entry points: the serve launcher."""
