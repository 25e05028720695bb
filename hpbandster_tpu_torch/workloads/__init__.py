"""Objectives of the port."""
