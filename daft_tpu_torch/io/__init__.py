"""File IO (counterpart of daft_tpu/io/, the local Parquet and CSV subset),
with no pyarrow: the Parquet format (io/_thrift.py, io/_parquet_format.py)
and its codecs (io/codecs.py, the snappy codec in io/csrc/snappy.cpp) are
the port's own."""
