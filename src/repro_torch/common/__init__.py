"""Configuration dataclasses and the parameter-definition system."""
