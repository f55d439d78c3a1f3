"""External-format integrations (the HDF5 filter's equivalent, the
netCDF and ADIOS readers)."""
