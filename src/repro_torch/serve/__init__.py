"""Serving layer of the port (counterpart of :mod:`repro.serve`)."""
