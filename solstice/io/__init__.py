"""Asset I/O (reference: solr/io/ — OBJReader, PDBReader, SWCReader,
FileMarshaller — and solr/images/ImageLoader)."""

from solstice.io.obj import load_obj
from solstice.io.pdb import load_pdb
from solstice.io.swc import load_swc
from solstice.io.irt import save_scene, load_scene
from solstice.io.image import load_image

__all__ = [
    "load_obj",
    "load_pdb",
    "load_swc",
    "save_scene",
    "load_scene",
    "load_image",
]
