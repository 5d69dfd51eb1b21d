"""File boundary of the port: bed scanning, a minimal HDF5 writer and
reader, and cooler files (no pandas, no h5py)."""
