"""Sharding rules and explicit collectives over a ``DeviceMesh``."""
