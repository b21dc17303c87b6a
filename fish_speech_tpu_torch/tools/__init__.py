"""Command-line entry points, each run as `python -m
fish_speech_tpu_torch.tools.<name>`: api_server and tts_cli (serving),
build_dataset, create_train_split, train and merge_lora (training)."""
