"""The TSR (Lean) system."""
