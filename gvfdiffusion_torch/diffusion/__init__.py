"""Noise schedules and the DPM-Solver++ sampler."""
