"""Decoder model of the port: layers, attention, transformer, model API."""
