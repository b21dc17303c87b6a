"""Modded-DAC codec, decode side."""
