"""SIGALRM-based execution time limit (port of salve_tpu/utils/function_timeout.py)."""

import signal


class timeout:
    """Context manager that raises TimeoutError after `seconds` (main thread only)."""

    def __init__(self, seconds: int = 1, error_message: str = "Timeout") -> None:
        self.seconds = seconds
        self.error_message = error_message

    def handle_timeout(self, signum: int, frame) -> None:
        raise TimeoutError(self.error_message)

    def __enter__(self) -> None:
        signal.signal(signal.SIGALRM, self.handle_timeout)
        signal.alarm(self.seconds)

    def __exit__(self, type, value, traceback) -> None:
        signal.alarm(0)
