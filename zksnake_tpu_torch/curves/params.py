"""Curve parameter sets for BN254 (alt_bn128) and BLS12-381.

Values match arkworks ark-bn254 / ark-bls12-381 configurations, which back the
reference native core (upstream zksnake: src/{bn254,bls12_381}/curve.rs).
"""

from ..constant import (
    BN254_MODULUS,
    BN254_SCALAR_FIELD,
    BLS12_381_MODULUS,
    BLS12_381_SCALAR_FIELD,
)


class CurveParams:
    def __init__(
        self,
        name,
        p,
        r,
        b,
        b2,
        g1_gen,
        g2_gen,
        xi,
        twist_type,
        x_param,
        ate_loop,
        ate_loop_neg,
        fq_bytes,
        fr_two_adicity,
        fr_generator,
        g1_cofactor,
        g2_cofactor,
    ):
        self.name = name
        self.p = p  # base field modulus
        self.r = r  # scalar field modulus (group order)
        self.b = b  # G1: y^2 = x^3 + b
        self.b2 = b2  # G2 twist: y^2 = x^3 + b2  (b2 in Fq2)
        self.g1_gen = g1_gen  # (x, y)
        self.g2_gen = g2_gen  # ((x0,x1), (y0,y1))
        self.xi = xi  # sextic twist constant in Fq2 (w^6 = xi)
        self.twist_type = twist_type  # 'D' (divisive) or 'M' (multiplicative)
        self.x_param = x_param  # BN/BLS family parameter
        self.ate_loop = ate_loop  # |Miller loop count|
        self.ate_loop_neg = ate_loop_neg  # True if loop count is negative
        self.fq_bytes = fq_bytes  # serialized base-field element size
        self.fr_two_adicity = fr_two_adicity
        self.fr_generator = fr_generator
        self.g1_cofactor = g1_cofactor
        self.g2_cofactor = g2_cofactor

    @property
    def fr_two_adic_root(self):
        """Primitive 2^two_adicity root of unity in Fr (arkworks convention:
        generator^((r-1) >> two_adicity))."""
        return pow(self.fr_generator, (self.r - 1) >> self.fr_two_adicity, self.r)


_BN_X = 4965661367192848881

BN254 = CurveParams(
    name="BN254",
    p=BN254_MODULUS,
    r=BN254_SCALAR_FIELD,
    b=3,
    # b2 = 3 / (9 + u)
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g1_gen=(1, 2),
    g2_gen=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    xi=(9, 1),
    twist_type="D",
    x_param=_BN_X,
    ate_loop=6 * _BN_X + 2,
    ate_loop_neg=False,
    fq_bytes=32,
    fr_two_adicity=28,
    fr_generator=5,
    g1_cofactor=1,
    g2_cofactor=21888242871839275222246405745257275088844257914179612981679871602714643921549,
)

_BLS_X = 0xD201000000010000  # |x|; actual parameter is -x

BLS12_381 = CurveParams(
    name="BLS12_381",
    p=BLS12_381_MODULUS,
    r=BLS12_381_SCALAR_FIELD,
    b=4,
    b2=(4, 4),  # 4 * (1 + u)
    g1_gen=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
    g2_gen=(
        (
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
        ),
        (
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
    ),
    xi=(1, 1),
    twist_type="M",
    x_param=-_BLS_X,
    ate_loop=_BLS_X,
    ate_loop_neg=True,
    fq_bytes=48,
    fr_two_adicity=32,
    fr_generator=7,
    g1_cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    g2_cofactor=0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5,
)

CURVES = {
    "BN254": BN254,
    "BN128": BN254,
    "ALT_BN128": BN254,
    "BLS12_381": BLS12_381,
}
