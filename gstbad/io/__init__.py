from gstbad.io import gdp  # noqa: F401
from gstbad.io import y4m  # noqa: F401
from gstbad.io import pnm  # noqa: F401
from gstbad.io import jpeg  # noqa: F401
