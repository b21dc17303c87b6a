"""Checkpoint IO (the port's own safetensors reader and writer), the
steady-state probe and file helpers."""
