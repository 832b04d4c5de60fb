from .select import (  # noqa: F401
    connected_components,
    parse_query,
    query_uses_elements,
    select,
    select_mask,
)
from .elements import ensure_elements, guess_element  # noqa: F401
