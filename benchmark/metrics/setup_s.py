"""setup_s: seconds from the process's start to the window's opening
(imports, the kernels' build or load, the weights' draw, the engine's
build, the warm-up and the clients' first admissions)."""


def read(run: dict) -> float:
    return run["setup_s"]
