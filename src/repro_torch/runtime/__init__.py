"""Fault tolerance and elastic re-planning for MBProx training."""
