"""The one name of the reference's remote store client
(`kubernetes_tpu.store.remote`) that the port reaches: `APIStatusError`,
which the event recorder drops like the store's own write errors. The HTTP
client itself has no copy here.
"""
from __future__ import annotations


class APIStatusError(Exception):
    """Non-2xx response that maps to no store error (e.g. 422 admission
    rejection): carries the server's Status reason/message."""

    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{code} {reason}: {message}")
        self.code = code
        self.reason = reason
        self.message = message
