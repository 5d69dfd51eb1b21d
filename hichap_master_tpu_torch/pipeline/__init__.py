"""Pipeline stages of the port (contact-matrix construction)."""
