"""Checkpoint IO (the port's own safetensors reader and writer), the
steady-state probe, file helpers, the log-mel spectrogram, profiling
accounting and ranked logging."""
