"""Sharding over a DeviceMesh: logical-axis hints and the param, cache
and input specs (counterpart of :mod:`repro.parallel`)."""
