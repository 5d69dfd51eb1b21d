"""Pipeline stages of the port (filtering and allelic assignment,
contact-matrix construction)."""
