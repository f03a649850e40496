"""Receiver models of the port."""

from .uplink import UplinkReceiver

__all__ = ["UplinkReceiver"]
