"""Command-line entry points, each run as `python -m
fish_speech_tpu_torch.tools.<name>`: api_server, tts_cli and api_client
(serving), build_dataset, create_train_split, train and merge_lora
(training), quantize, extract_vq, quant_drift, eval_quality,
eval_in_context, latency_bench and profile_decode (the rest of the JAX
package's tools)."""
