"""Evaluation-run notifier.

A copy of ``visual_odom_tpu/utils/notify.py`` (no JAX in it): the useful
contract of the devkit's ``Mail`` class (reference
src/evaluate/mail.h:8-46). Every ``msg()`` goes to stdout and, when an
email address is configured, is kept and handed to sendmail at close. A
host without sendmail just prints: notification never fails an eval.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


class Notifier:
    """stdout and optional email notification sink for long eval runs."""

    def __init__(self, email: str = "",
                 subject: str = "KITTI Evaluation Benchmark"):
        self.email = email
        self.subject = subject
        self._lines: list[str] = []

    def msg(self, text: str, *args) -> None:
        """Print a line; keep it for the email body if one is configured."""
        line = (text % args) if args else text
        print(line, flush=True)
        if self.email:
            self._lines.append(line)

    def close(self) -> None:
        """Send the kept body through sendmail, if configured and present."""
        if not (self.email and self._lines):
            return
        sendmail = shutil.which("sendmail") or "/usr/lib/sendmail"
        body = (f"To: {self.email}\nSubject: {self.subject}\n\n\n"
                + "\n".join(self._lines) + "\n")
        try:
            subprocess.run([sendmail, "-t"], input=body.encode(),
                           timeout=30, check=False)
        except (OSError, subprocess.TimeoutExpired):
            pass  # notification is best-effort by design
        self._lines = []

    def __enter__(self) -> "Notifier":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
