from .wav import read_raw, read_wav, write_raw, write_wav  # noqa: F401
