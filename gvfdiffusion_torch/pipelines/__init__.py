"""End-to-end inference pipelines."""
