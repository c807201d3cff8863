"""Native C++ host components of the port (OBJ parsing, PNG encoding, mip
chains), built with g++ on first use; see ``xr_torch.native.api``."""
