"""Model layers of the port (counterpart of :mod:`repro.models`)."""
