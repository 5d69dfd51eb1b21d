"""File boundary of the port: bed scanning, a minimal HDF5 writer and
reader, and cooler files (no pandas, no h5py), with the names that the JAX
package's ``io`` exports."""

from .cooler import CoolerWriter, CoolerReader, write_cooler, list_resolutions
