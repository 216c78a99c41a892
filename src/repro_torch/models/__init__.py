"""Dense GQA decoder stack of the port (plain functions on param dicts)."""
