"""Checkpoint IO (the port's own safetensors reader and writer) and the
steady-state probe."""
