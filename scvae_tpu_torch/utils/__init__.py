"""Helpers that several layers of the port share."""
