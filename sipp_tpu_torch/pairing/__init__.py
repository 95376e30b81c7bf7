from .ate import (  # noqa: F401
    cross_products,
    final_exp,
    inner_product,
    miller_loop,
    product_tree,
)
