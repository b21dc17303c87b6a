"""Dual-AR transformer: config, init, forward passes, decode loop."""
