"""Decode engine and cascade generation of the port."""
