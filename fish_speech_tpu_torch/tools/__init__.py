"""Command-line entry points: `python -m fish_speech_tpu_torch.tools.api_server`
and `python -m fish_speech_tpu_torch.tools.tts_cli`."""
