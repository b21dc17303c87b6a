"""The HTTP server (serve/app.py) and what it needs, on the standard
library, numpy and scipy: its own msgpack codec and request schemas, WAV
helpers, mp3/opus through ctypes, the voice-reference store and the web
UI."""
