"""Receiver models of the port."""

from .streaming import StreamingDemodulator
from .uplink import UplinkReceiver

__all__ = ["StreamingDemodulator", "UplinkReceiver"]
