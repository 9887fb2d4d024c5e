"""Fault tolerance and elasticity around the port's task runtime."""
