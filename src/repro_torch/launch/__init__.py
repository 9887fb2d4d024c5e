"""Meshes, the roofline model and the dry-run (counterpart of
:mod:`repro.launch`)."""
