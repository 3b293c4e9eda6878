"""Offline tooling of the port: WER scoring and decode-file cleaning."""
