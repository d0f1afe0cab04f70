"""Fault tolerance: failure injection, straggler detection, supervisors."""
