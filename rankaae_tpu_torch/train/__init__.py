"""The faithful training protocol and its reference-compatible facade."""
