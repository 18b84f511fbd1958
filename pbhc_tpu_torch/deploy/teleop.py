"""Teleoperation marker source (counterpart of `pbhc_tpu/deploy/teleop.py`, a
copy; reference motion_tracking.py:112-118,137-138).

The reference gates a ROS2 subscriber on `env.config.use_teleop_control`,
storing VisionPro 3-point marker coords into a [N,3,3] buffer. ROS2 is not a
dependency of this framework, so the transport is a small stdlib UDP listener
speaking the same payload (9 float64 per datagram = one 3x3 marker set,
broadcast to all envs); anything that can send UDP (including a thin ROS2
bridge node) can drive it.

    src = TeleopSource(port=9870)
    src.start()
    coords = src.coords          # np [3,3], updated by the listener thread
    src.stop()

Port 0 binds a free port, which `src.addr` names after `start()`.
"""
from __future__ import annotations

import socket
import struct
import threading

import numpy as np


class TeleopSource:
    """Background UDP listener for 3x3 teleop marker coordinates."""

    def __init__(self, port: int = 9870, host: str = "127.0.0.1"):
        self.addr = (host, port)
        self.coords = np.zeros((3, 3), dtype=np.float64)
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(self.addr)
        sock.settimeout(0.2)
        self.addr = sock.getsockname()
        self._sock = sock

        def loop():
            while not self._stop.is_set():
                try:
                    data, _ = sock.recvfrom(1024)
                except socket.timeout:
                    continue
                if len(data) >= 72:
                    vals = struct.unpack("<9d", data[:72])
                    self.coords = np.asarray(vals, dtype=np.float64).reshape(3, 3)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """End the listener thread and close its socket."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            if self._thread.is_alive():
                raise RuntimeError("teleop listener did not stop within 1 s")
            self._thread = None
            self._sock.close()

    @staticmethod
    def send(coords, port: int = 9870, host: str = "127.0.0.1"):
        """Publish one marker set (test/bridge helper)."""
        payload = struct.pack("<9d", *np.asarray(coords, dtype=np.float64).reshape(-1))
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.sendto(payload, (host, port))
