"""Logging and stage timing of the port's command line (copies of the JAX
package's ``utils``)."""

from .logging import MAIN, get_logger, setup_logging
